"""Plain references, one module a chain (the name a traffic mix gives as
``chain``): plain torch and numpy/scipy only, nothing of the program. Each
has ``sample_rows``, ``compare`` and ``control``."""
