"""The port's serving stack: the paged mixed-step engine and its host
helpers."""
