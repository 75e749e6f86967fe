"""Data-preparation helpers of the port (numpy only)."""
