"""The drivers: one module a kind of traffic, named by the traffic files."""
