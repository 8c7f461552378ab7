"""The language models of the port: the counterparts of ``repro.models``
(the dense decoder-only transformer and RWKV6 so far; ROADMAP.md,
item 10)."""
