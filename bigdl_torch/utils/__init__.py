"""Configuration, the CUDA build, and weight carry-over."""
