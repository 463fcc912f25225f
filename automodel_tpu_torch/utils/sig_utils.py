"""Preemption signals (counterpart: ``automodel_tpu/utils/sig_utils.py``).

:class:`DistributedSignalHandler` traps one or more signals (SIGTERM and
SIGINT: a preemption and an operator's ^C take the same grace-window save)
and records that one arrived.
:meth:`~DistributedSignalHandler.signals_received` gathers the flag
across the ranks of the process group (the JAX ``process_allgather``), so
that every rank takes the grace-window save together.
On exit the previous handlers are restored (``SIG_DFL`` for one installed
from C, which Python cannot re-install), and a callable previous handler
is chained; the stdlib ^C handler only on the second ^C, so the first one
takes the save and a second one still aborts a run that hangs.
"""

from __future__ import annotations

import signal
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union


class DistributedSignalHandler:
    def __init__(self,
                 sig: Union[int, Sequence[int]] = signal.SIGTERM,
                 chain: bool = True):
        sigs: Tuple[int, ...] = (tuple(sig) if isinstance(sig, Iterable)
                                 else (sig,))
        if not sigs:
            raise ValueError("DistributedSignalHandler needs >= 1 signal")
        self.sigs = sigs
        self.sig = sigs[0]
        self.chain = chain
        self._received = False
        self._received_sig: Optional[int] = None
        self._prev_handlers: Dict[int, object] = {}
        self._hits: Dict[int, int] = {}

    def __enter__(self):
        self._received = False
        self._received_sig = None
        self._prev_handlers = {}
        self._hits = {}
        for s in self.sigs:
            self._prev_handlers[s] = signal.getsignal(s)
            signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev_handlers.items():
            signal.signal(s, prev if prev is not None else signal.SIG_DFL)
        self._prev_handlers = {}
        return False

    def _handler(self, signum, frame):
        self._received = True
        self._received_sig = signum
        self._hits[signum] = self._hits.get(signum, 0) + 1
        prev = self._prev_handlers.get(signum)
        if not (self.chain and callable(prev)
                and prev not in (signal.SIG_IGN, signal.SIG_DFL)):
            return
        if prev is signal.default_int_handler:
            # the first ^C only sets the flag (KeyboardInterrupt would
            # unwind before the grace-window save); a second one aborts
            if self._hits[signum] > 1:
                prev(signum, frame)
            return
        prev(signum, frame)

    @property
    def received(self) -> bool:
        return self._received

    @property
    def received_signal(self) -> Optional[int]:
        """The signal number that fired (None before any)."""
        return self._received_sig

    def signals_received(self) -> bool:
        """True if any rank received a trapped signal.  Collective when a
        process group of more than one rank exists: the flags are gathered
        over the host's gloo group, so a step's CUDA work is not waited
        on."""
        import torch
        import torch.distributed as dist

        from automodel_tpu_torch.distributed.init import host_group

        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return self._received
        flags = [torch.zeros(1, dtype=torch.int32)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(flags, torch.tensor(
            [1 if self._received else 0], dtype=torch.int32),
            group=host_group())
        return bool(torch.cat(flags).any())


def get_signal_name(sig: Optional[int]) -> str:
    try:
        return signal.Signals(sig).name
    except (ValueError, TypeError):
        return str(sig)
