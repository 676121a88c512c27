"""Launch entry points of the port: the serving CLI (:mod:`.serve`), the
training CLI (:mod:`.train`) and the filter mesh (:mod:`.mesh`)."""
