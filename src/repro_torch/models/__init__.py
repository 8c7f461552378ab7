"""The language models of the port: the counterparts of ``repro.models``
(the dense decoder-only transformer and RWKV6 so far; MoE, zamba2 and
the cross-attention families are in ROADMAP.md, "Modules still to
port")."""
