"""Evaluation: metrics, protocols and the demo render loops."""
