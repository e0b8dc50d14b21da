"""Training-step builders of the port (sparse fine-tuning)."""
