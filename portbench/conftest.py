"""pytest settings of the benchmark's own tests (`portbench/tests`)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "card: needs an NVIDIA card; the test itself skips when none is "
        "visible (run them on the card with `python3 -m pytest -m card "
        "portbench/tests`)")
