"""Array-level ops on channels-first tensors ``(..., T)``."""
