"""Architecture configurations: the schema (``base``), the ten published
configs and their reduced variants (``registry.get_config``)."""
