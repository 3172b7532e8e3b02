"""repro_torch.apps subpackage."""
