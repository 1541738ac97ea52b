"""The minibatch reader decorator. The port's own copy of
``paddle_tpu/batch.py`` (pure Python)."""

__all__ = ['batch']


def batch(reader, batch_size, drop_last=False):
    """A reader of lists of ``batch_size`` instances of ``reader()``; the
    last, shorter list too unless ``drop_last``."""
    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    if batch_size <= 0:
        raise ValueError("batch_size should be a positive integer")
    return batch_reader
