"""Step functions and the serving launcher of the port."""
