"""Command-line front doors of the port."""
