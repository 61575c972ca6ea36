"""Command-line entry points of the port: `radiod-torch`, the daemon."""
