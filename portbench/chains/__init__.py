"""The program's side of each traffic mix: one module a chain (the name a
traffic mix gives as ``chain``), with ``Program`` (set-up, one call, the
outputs read back for the comparison) and ``work`` (what a call does)."""
