"""Configuration, the CUDA build, weight carry-over, and the Engine's data
group."""
