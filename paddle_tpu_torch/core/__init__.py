"""Core utilities: errors, dtypes, places."""
