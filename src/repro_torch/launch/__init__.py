"""Launch entry points of the port: the serving CLI's routing layer
(:mod:`.serve`)."""
