"""AdamW with int8 moments and the int8 gradient compressor (port of
``repro.optim``)."""
