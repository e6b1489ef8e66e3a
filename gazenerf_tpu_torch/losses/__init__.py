"""The training loss stack."""
