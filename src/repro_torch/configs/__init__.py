"""Architecture configs of the port (``base`` holds the registry)."""
