"""dtype helpers and the ``.npz`` bundle format (numpy only)."""
