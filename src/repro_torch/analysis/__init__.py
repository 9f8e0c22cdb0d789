"""Analysis tools of the port (the sweep report renderer)."""
