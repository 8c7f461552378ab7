"""The language models of the port: the counterparts of ``repro.models``
(the decoder-only transformer, dense and MoE, and RWKV6; zamba2 and the
cross-attention families are in ROADMAP.md, "Modules still to port")."""
