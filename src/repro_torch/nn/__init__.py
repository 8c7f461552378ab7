"""The language-model layers of the port: the counterparts of
``repro.nn`` (attention, self and cross, the MLP and MoE blocks, RWKV6's
mixes, the Mamba2 (SSD) block, norms, embeddings, sampling).  A module
is a ``<module>_spec(cfg)`` tree of :class:`Param` and a
``<module>_apply(params, ...)`` function over tensors; the models of
``repro_torch.models`` hold the parameters in ``nn.Module``s built from
the specs."""
