"""Command-line tools of the port (``python -m bigdl_torch.tools.<name>``)."""
