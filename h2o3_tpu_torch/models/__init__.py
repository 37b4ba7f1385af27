"""Model framework, metrics and builders of the PyTorch port."""
