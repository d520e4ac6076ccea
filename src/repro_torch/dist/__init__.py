"""Distributed-training policy of the port: the bounded-staleness commit
controller."""
