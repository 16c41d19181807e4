"""Application layer of the port: the entity ``World`` over the geometry pool."""
