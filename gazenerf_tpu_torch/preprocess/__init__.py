"""Face normalization for the evaluation protocols."""
