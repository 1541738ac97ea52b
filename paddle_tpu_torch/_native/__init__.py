"""The port's counterpart of ``paddle_tpu/_native``: so far the pure-Python
path of its ``Tokenizer``. The native library (``csrc/``: the tokenizer's
C half, the process ring) waits for ROADMAP Queue 1 item 3b."""
