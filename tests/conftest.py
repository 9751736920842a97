

def pytest_configure(config):
    config.addinivalue_line("markers", "multidev: spawns a subprocess with 8 fake devices")
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU and the CUDA toolkit; skips without one"
    )
