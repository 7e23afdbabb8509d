"""Typed option vocabulary (`standard.enums`)."""
