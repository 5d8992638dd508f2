"""Matrix Market input of the port."""
