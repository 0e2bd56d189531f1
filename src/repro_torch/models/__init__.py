"""Dense decoder model of the port (schema, layers, attention, blocks)."""
