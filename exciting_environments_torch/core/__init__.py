"""Core runtime: dataclass structures, environment base classes, spaces, registry."""
