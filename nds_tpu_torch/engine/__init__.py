"""SQL engine of the port: host front end plus the torch device backend."""
