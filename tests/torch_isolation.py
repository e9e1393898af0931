"""Test isolation of the port's process-wide state.

The port keeps a process-wide registry of shared programs
(``nds_tpu_torch.engine.torch_backend.compiled._SHARED_PROGRAMS``): a
statement recorded by one session publishes its schedule under its plan
fingerprint, and any later session that plans the same statement adopts
it ("adopted" mode) instead of recording. Tests that run the same SQL over
the same tables in one process (one pytest worker runs several files)
would then see each other's schedules, and a test's modes would depend on
which tests ran before it. Every port test file that runs the compiled
lifecycle imports this autouse fixture, the counterpart of
``tests/conftest.py``'s for the reference's registry: the registry is
empty when a test starts and when it ends, and within one test it is
shared as usual.

Import it as ``from torch_isolation import isolate_port_programs  #
noqa: F401``; it imports neither jax nor nds_tpu, so the card-only test
files, run without tests/conftest.py, may import it too.
"""
import pytest


@pytest.fixture(autouse=True)
def isolate_port_programs():
    from nds_tpu_torch.engine.torch_backend.compiled import \
        clear_shared_programs
    clear_shared_programs()
    yield
    clear_shared_programs()
