"""The LM substrate's decoders, all ten architectures (``repro/models``)."""
