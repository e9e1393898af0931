"""Observability stubs the copied front end imports."""
