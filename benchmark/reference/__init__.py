"""Plain PyTorch references, one file a configuration (see ``README.md``)."""
