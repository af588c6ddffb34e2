"""Model configs: a copy of ``repro.configs`` (plain dataclasses + registry)."""
