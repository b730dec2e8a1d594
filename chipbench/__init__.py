"""The port's benchmark (see core.py)."""
