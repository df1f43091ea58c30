"""Analysis data of the port: the progress lint's allowlist for
``src/repro_torch``."""
