"""Configuration, the CUDA and host builds, weight and optimizer-state
carry-over, checkpoint files and their CRC32C, and the Engine's data
group."""
