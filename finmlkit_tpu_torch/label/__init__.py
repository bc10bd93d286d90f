"""Labels and sample weights."""
