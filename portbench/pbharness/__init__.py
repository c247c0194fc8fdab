"""The benchmark harness of the port: finds a cell's configuration, traffic
mix, per-layer metrics and limits by name, drives the port's timed path,
times it on the device's clock, traces it, and judges its outputs against
the plain reference (``pbreference``)."""
