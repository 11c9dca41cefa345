"""Root test configuration: build the native g++ libraries once, up front.

``elprep_tpu.native`` compiles ``libelprep_native.so`` straight onto its
final path and caches a failed load for the rest of the process. When
several pytest-xdist workers start on a checkout with no library yet,
they all build at once, and a worker that loads the half-written file
skips every native test it runs afterwards ("native lib unavailable").

Building both packages' libraries here, in the xdist controller (or the
single pytest process) before any worker starts, leaves the workers a
finished library to load. Neither ``native`` module imports jax.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    import elprep_tpu.native
    import elprep_tpu_torch.native

    elprep_tpu.native.available()
    elprep_tpu_torch.native.available()
