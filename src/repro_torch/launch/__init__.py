"""Entry points of the port: the counterparts of ``repro.launch`` (the
serving launcher so far; ROADMAP.md, item 10)."""
