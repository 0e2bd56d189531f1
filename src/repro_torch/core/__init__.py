"""Control layer of the port: malleability parameters, policies and
redistribution helpers (no framework code except the device repack)."""
