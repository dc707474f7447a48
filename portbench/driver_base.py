"""What every driver of an entry point shares.

A driver (``portbench/drivers/<name>.py``, named by a configuration's
``driver`` key) builds a cell's inputs from the seed, runs one call of the
entry point the window drives, keeps what the reference needs to judge the
answers, and knows which of the program's functions its traced ranges wrap.
The harness (``portbench/core.py``) owns the window, the trace and the
result line.
"""
from __future__ import annotations

from contextlib import ExitStack, contextmanager, nullcontext
from typing import Iterator, Optional, Tuple


class World:
    """This process's place in a multi-card run."""

    def __init__(self, rank: int, size: int, flags_group):
        self.rank, self.size, self.flags_group = rank, size, flags_group


def scheme_params(config: dict):
    """(the program's, the plain reference's) parameters of ``config``'s
    security level; raises unless both have the degree, rank and modulus
    that the configuration states."""
    from fusion_cryptography_tpu_torch.params import fusion_setup

    from portbench.reference import fusion_ref as ref

    program = fusion_setup(config["secpar"], config["setup_seed"])
    reference = ref.setup(config["secpar"], config["setup_seed"])
    for key in ("degree", "rank", "modulus"):
        if not getattr(program, key) == getattr(reference, key) == config[key]:
            raise ValueError(f"{key}: the configuration states {config[key]}, the program runs "
                             f"{getattr(program, key)}, the reference {getattr(reference, key)}")
    return program, reference


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, world: Optional[World]):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.world = world
        self.ranges = False

    # -- the run
    def setup(self) -> None:
        """Build the inputs from the seed and warm up every shape."""
        raise NotImplementedError

    def call(self, i: int) -> int:
        """Call ``i`` of the run; returns the answers it produced."""
        raise NotImplementedError

    def work(self, i: int) -> Optional[dict]:
        """The work of call ``i`` for the roofline (``roofline.py``), if counted."""
        return None

    def release(self) -> None:
        """Free the program's device state before the reference runs."""

    def check(self) -> dict:
        """{name: (number, limit)} of the comparison with the reference; a
        multi-card driver returns its rank's part, which its module's
        ``merge_checks`` combines."""
        raise NotImplementedError

    # -- tracing
    def span(self, name: str):
        """A named range while the segment is traced, else nothing."""
        if not self.ranges:
            return nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def wraps(self) -> Tuple[Tuple[object, str, str], ...]:
        """(owner, attribute, range name) of each program function a traced
        segment wraps in a range."""
        return ()

    @contextmanager
    def instrument(self) -> Iterator[None]:
        from torch.profiler import record_function

        with ExitStack() as stack:
            for owner, attr, name in self.wraps():
                stack.enter_context(_patched(owner, attr, name, record_function))
            self.ranges = True
            try:
                yield
            finally:
                self.ranges = False


@contextmanager
def _patched(owner, attr: str, name: str, record_function):
    fn = getattr(owner, attr)
    had_own = attr in getattr(owner, "__dict__", {})

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        if had_own:
            setattr(owner, attr, fn)
        else:
            delattr(owner, attr)
