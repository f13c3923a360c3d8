"""Entry points of the port's serving lane (:mod:`.serve`)."""
