"""Device serving layer of the port: snapshots, steps, QueryEngine."""
