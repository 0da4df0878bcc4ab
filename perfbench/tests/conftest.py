def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with the CUDA toolkit; skips on a machine without one",
    )
