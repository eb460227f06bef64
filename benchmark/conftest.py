"""pytest settings of the benchmark's own tests (benchmark/tests): the
`card` marker of tests that need a CUDA card, which skip elsewhere."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
