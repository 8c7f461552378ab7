"""The language models of the port: the counterparts of ``repro.models``
(the dense decoder-only transformer so far; ROADMAP.md, item 10)."""
