"""Training: per-sample offsets, per-group Adam, the train step and the epoch loop."""
