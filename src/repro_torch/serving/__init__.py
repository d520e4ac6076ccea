"""Serving layer of the port: the continuous-batching engine with the
paper's admission schedulers (:mod:`.engine`)."""
