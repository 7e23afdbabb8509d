"""Host-side helpers used by the ported ops."""
