"""Generator (the sampling path)."""
