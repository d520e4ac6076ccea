"""Architecture configs of the port (:mod:`.registry`)."""
