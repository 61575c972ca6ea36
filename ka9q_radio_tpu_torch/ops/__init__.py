"""Signal-processing operators of the port (torch tensors, host numpy helpers)."""
