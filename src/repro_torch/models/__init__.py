"""Dense-LM model code of the port (single device)."""
