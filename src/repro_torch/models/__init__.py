"""The LM substrate's dense decoders (``repro/models`` for ``family="dense"``)."""
