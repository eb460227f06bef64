"""Share of the frame-rows the serving calls computed that were padding:
the batcher's rows up to a power of two and each row's frames up to its
length bucket (the masks handed to synthesise_batch)."""


def read(view):
    computed = sum(rows * bucket for _, bucket, rows in view.calls)
    real = sum(sum(lengths) for lengths, _, _ in view.calls)
    return None if computed == 0 else 100.0 * (1.0 - real / computed)
