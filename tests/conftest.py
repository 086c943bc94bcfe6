# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device; only launch/dryrun fakes 512 devices.
import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)"
    )
