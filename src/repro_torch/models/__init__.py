"""The language models of the port: the counterparts of ``repro.models``
(the decoder-only transformer, dense and MoE; RWKV6; the zamba2 hybrid of
Mamba2 blocks and a shared attention block; the cross-attention families:
the llama-3.2-vision decoder ``VisionLM`` and the encoder-decoder
``EncDecLM``)."""
