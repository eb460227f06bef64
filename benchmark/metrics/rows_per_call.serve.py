"""Real requests per device call of the batcher."""


def read(view):
    if not view.calls:
        return None
    return sum(len(lengths) for lengths, _, _ in view.calls) / len(view.calls)
