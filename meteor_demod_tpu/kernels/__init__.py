"""Hand-written device kernels (see kernels/recurrence.py)."""
