"""Channels and the TAPA communication interface (paper Section 3.1.2).

A :class:`Channel` is a bounded FIFO connecting exactly one producer task to
one consumer task.  The producer holds an :class:`OStream` view, the consumer
an :class:`IStream` view; together they expose the full interface of the
paper's Table 2:

    ostream:  full()  write()  try_write()  close()  try_close()
    istream:  empty() peek()  try_peek()   read()   try_read()
              eot()  try_eot()  open()  try_open()

plus the burst extension (hardware FIFOs amortize per-token handshake cost
with wide/burst transfers; we do the same in software):

    ostream:  write_burst(seq)   try_write_burst(seq)
    istream:  read_burst(n)  try_read_burst(n)  read_transaction()

End-of-transaction (EoT) tokens are out-of-band: they carry no data, occupy
one slot of channel capacity, and let a consumer terminate a pipelined loop
without extending the data type (paper Listing 2).

Blocking semantics are engine-mediated: a blocking operation calls
``runtime.wait(channel, side)`` which either waits (thread engine), performs
a cooperative hand-off (coroutine engine), or raises
:class:`~repro_torch.core.errors.SequentialSimulationError` (sequential engine,
reproducing the paper's documented failure mode).

Run-to-block fast path: in the coroutine engine exactly one task runs at a
time, so channel state needs **no locking** — the paper's "collaborative
instead of preemptive" insight.  Engines advertise this via
``runtime.fast_path``; when set, an operation on a channel that can make
progress *and has no parked waiters on the opposite side* mutates the deque
directly and never enters the engine at all.  Only a genuine stall (or a
required wakeup) pays for runtime dispatch.

Chaos-harness contract: channel-level fault injection (repro_torch.core.faults)
hooks the *engine-side* push/pop paths, never the channel itself, so this
file stays fault-free by construction.  Engines disable ``fast_path`` only
when an armed :class:`~repro_torch.core.faults.FaultInjector` actually targets
channels or tasks (``affects_channels``); an empty/no-op plan keeps
``fast_path`` on, which is what makes the "zero overhead when no plan"
guarantee structural rather than measured.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Generic, Optional, Sequence, TypeVar

import numpy as np
import torch

from .context import current_runtime
from .errors import ChannelMisuse, EndOfTransaction

T = TypeVar("T")

_uid = itertools.count()


class _EotType:
    """Singleton end-of-transaction token."""

    _instance: Optional["_EotType"] = None

    def __new__(cls) -> "_EotType":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "<EoT>"


EOT = _EotType()

# Sides, used by engines to know which waiters to wake.
READABLE = "readable"
WRITABLE = "writable"


_TORCH_TO_NP = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64, torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}


def np_dtype(dtype: Any) -> np.dtype:
    """The numpy dtype of a numpy or torch dtype (torch dtypes have no
    ``np.dtype`` conversion of their own); raises TypeError otherwise."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_NP:
            raise TypeError(f"torch dtype {dtype} has no numpy counterpart")
        return np.dtype(_TORCH_TO_NP[dtype])
    return np.dtype(dtype)


def _norm_dtype(dtype: Any) -> Any:
    """Normalize a declared element dtype through numpy when possible
    (torch dtypes included, so declarations compare equal across both
    frameworks); anything numpy cannot interpret is kept verbatim
    (documentation-only, never enforced)."""
    if dtype is None:
        return None
    try:
        return np_dtype(dtype)
    except TypeError:
        return dtype


class Channel(Generic[T]):
    """Bounded FIFO channel (paper Section 3.1.1/3.1.3).

    ``capacity`` bounds the number of in-flight tokens exactly as in TAPA's
    ``tapa::channel<T, capacity>``; the simulator reserves enough state to
    honor it precisely (Section 3.2).

    ``_rwait``/``_wwait`` are the per-channel waiter lists: fibers parked on
    this channel's readable/writable side.  Keeping them *on the channel*
    makes wakeup O(1) (no engine-global dict lookup) and lets the stream
    fast path test "does anybody need a wakeup?" with one truthiness check.
    The thread engine keeps its own condition variables and leaves these
    empty.
    """

    __slots__ = (
        "name", "capacity", "dtype", "shape", "_q", "uid",
        "producer", "consumer", "parent", "iface",
        "total_written", "total_read", "max_occupancy",
        "_rwait", "_wwait", "_eot_count",
    )

    def __init__(self, capacity: int = 2, name: Optional[str] = None,
                 dtype: Any = None, shape: Optional[tuple] = None):
        if not isinstance(capacity, int) or isinstance(capacity, bool) \
                or capacity < 1:
            raise ValueError("channel capacity must be a static int >= 1")
        self.uid = next(_uid)
        self.name = name or f"ch{self.uid}"
        self.capacity = capacity
        # element spec (paper: tapa::channel<T, capacity> — T is part of the
        # type).  ``dtype`` is normalized when numpy understands it; a
        # non-normalizable dtype stays as documentation only.  ``shape`` is
        # the per-token array shape (() for scalar tokens); synthesis
        # requires both, simulation enforces them under track_stats.
        self.dtype = _norm_dtype(dtype)
        self.shape = tuple(shape) if shape is not None else None
        # ``_q``/``_eot_count``/waiters are also the channel's *snapshot
        # surface*: ft/recovery.py capture_channel/restore_channel freeze
        # and rebuild exactly these between runs (never mid-run), so any
        # new mutable field here needs a matching capture.
        self._q: deque = deque()
        # Per-channel waiter lists (coroutine engine: (fiber, epoch) pairs).
        self._rwait: deque = deque()
        self._wwait: deque = deque()
        # Number of EoT tokens currently in the queue: lets a burst read
        # size itself in O(1) (no head scan) on the common all-data case.
        self._eot_count = 0
        # Endpoint bookkeeping for graph metadata extraction (Section 3.4).
        self.producer = None   # task instance acting as producer
        self.consumer = None   # task instance acting as consumer
        self.parent = None     # parent task that instantiated this channel
        self.iface = None      # owning interface (async_mmap port channels)
        # Statistics (opt-in: engines update these only under
        # ``track_stats=True``, at burst granularity; the default hot path
        # does no bookkeeping).
        self.total_written = 0
        self.total_read = 0
        self.max_occupancy = 0

    # -- element spec ------------------------------------------------------
    def has_spec(self) -> bool:
        """True when this channel declares an enforceable element spec."""
        return self.shape is not None or isinstance(self.dtype, np.dtype)

    def check_token(self, tok: Any, task: Any = None) -> None:
        """Validate one data token against the declared element spec.

        Engines call this under ``track_stats`` (the debug mode) on every
        push; the error names the channel and the pushing task so a typed
        graph fails at the *write* that broke the contract, not at some
        downstream consumer."""
        if tok is EOT:
            return
        who = f" (task {task.name!r})" if task is not None else ""
        if self.shape is not None:
            got = tuple(np.shape(tok))
            if got != self.shape:
                raise ChannelMisuse(
                    f"channel {self.name!r} declares element shape "
                    f"{self.shape}; got a token of shape {got}{who}")
        if isinstance(self.dtype, np.dtype):
            got_dt = getattr(tok, "dtype", None)
            if got_dt is not None:
                try:
                    same = np_dtype(got_dt) == self.dtype
                except TypeError:   # e.g. bfloat16: no numpy counterpart
                    same = False
                if not same:
                    raise ChannelMisuse(
                        f"channel {self.name!r} declares element dtype "
                        f"{self.dtype}; got a token of dtype {got_dt}{who}")
            else:
                # Python scalars are checked by kind only (an int literal
                # on an int32 channel is fine); arbitrary objects on a
                # dtype-declared channel are not
                ok = isinstance(tok, (bool, int, float, complex)) and \
                    np.dtype(type(tok)).kind == self.dtype.kind
                if not ok:
                    raise ChannelMisuse(
                        f"channel {self.name!r} declares element dtype "
                        f"{self.dtype}; got a {type(tok).__name__} "
                        f"token{who}")

    # -- raw state ---------------------------------------------------------
    def is_empty(self) -> bool:
        return not self._q

    def is_full(self) -> bool:
        return len(self._q) >= self.capacity

    def size(self) -> int:
        return len(self._q)

    # -- endpoint registration (one producer + one consumer, Section 3.1.1)
    def _bind(self, side: str, task: Any) -> None:
        if task is None:
            return
        cur = getattr(self, side)
        if cur is None:
            setattr(self, side, task)
        elif cur is not task:
            raise ChannelMisuse(
                f"channel {self.name!r} already has a {side} "
                f"({cur!r}); cannot also bind {task!r}")

    # -- raw queue ops (no blocking, no stats; engines guarantee
    #    exclusivity or hold the engine lock around these) -----------------
    def _push(self, tok: Any) -> None:
        if tok is EOT:
            self._eot_count += 1
        self._q.append(tok)

    def _pop(self) -> Any:
        tok = self._q.popleft()
        if tok is EOT:
            self._eot_count -= 1
        return tok

    def _head(self) -> Any:
        return self._q[0]

    def _data_run(self, limit: int) -> int:
        """Length of the run of consecutive *data* tokens at the head,
        capped at ``limit`` — how many tokens a burst read may consume
        without crossing an EoT.  O(1) when no EoT is in flight."""
        q = self._q
        if not self._eot_count:
            n = len(q)
            return n if n < limit else limit
        k = 0
        for tok in q:
            if k >= limit or tok is EOT:
                break
            k += 1
        return k

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"Channel({self.name!r}, cap={self.capacity}, "
                f"size={len(self._q)})")


def _rt():
    rt = current_runtime()
    if rt is None:
        raise RuntimeError(
            "stream operation outside a running task; run the program via "
            "repro_torch.run(...)/an engine, or use Channel._push/_pop directly")
    return rt


class IStream(Generic[T]):
    """Consumer-side view of a channel (paper Table 2 + burst extension)."""

    __slots__ = ("_chan",)

    def __init__(self, chan: Channel):
        self._chan = chan

    @property
    def channel(self) -> Channel:
        return self._chan

    # -- non-blocking state tests -----------------------------------------
    def empty(self) -> bool:
        return self._chan.is_empty()

    # -- blocking ops ------------------------------------------------------
    def read(self) -> T:
        """Blocking read of a data token.

        Reading an EoT token is a protocol error (EoT carries no data);
        use ``eot()``/``open()`` to handle transaction boundaries.
        """
        c = self._chan
        rt = _rt()
        q = c._q
        if q and rt.fast_path and not c._wwait:
            # run-to-block fast path: token available, no parked writer to
            # wake — consume without entering the engine
            tok = q[0]
            if tok is EOT:
                raise EndOfTransaction(
                    f"read() reached EoT on channel {c.name!r}")
            return q.popleft()
        while c.is_empty():
            rt.wait(c, READABLE)
        if c._head() is EOT:
            # do not consume: the channel state is unchanged, so the caller
            # can recover with open()/eot() after handling the error
            raise EndOfTransaction(
                f"read() reached EoT on channel {c.name!r}")
        return rt.pop(c)

    def read_burst(self, n: int) -> list:
        """Blocking burst read: consume and return ``n`` data tokens.

        Equivalent to ``n`` scalar ``read()`` calls, except that an EoT
        terminates the burst instead of raising: tokens are consumed from
        the head in batches as they become available, and the burst stops
        early — *without* consuming the EoT — if the transaction ends
        first.  Returns a list of length ``n``, or shorter iff an EoT was
        reached (empty iff the head token already is EoT).

        One runtime interaction per batch, not per token: this is the
        software analogue of a hardware FIFO burst transfer.
        """
        if n < 0:
            raise ValueError("read_burst size must be >= 0")
        c = self._chan
        rt = _rt()
        q = c._q
        out: list = []
        while len(out) < n:
            if not q:
                rt.wait(c, READABLE)
                continue
            want = n - len(out)
            k = c._data_run(want) if rt.fast_path else rt.data_run(c, want)
            if k == 0:
                break                       # head is EoT: burst ends early
            if rt.fast_path and not c._wwait:
                if k == len(q):             # drain-all: one C-level copy
                    out.extend(q)
                    q.clear()
                else:
                    out.extend(q.popleft() for _ in range(k))
            else:
                out.extend(rt.pop_burst(c, k))
        return out

    def read_transaction(self) -> list:
        """Blocking read of one whole transaction: every data token up to
        the next EoT, *consuming* the EoT.  Equivalent to draining
        ``for v in stream`` into a list, at burst granularity."""
        c = self._chan
        n = max(c.capacity, 32)
        out: list = []
        while True:
            chunk = self.read_burst(n)
            out.extend(chunk)
            if len(chunk) < n:              # short burst <=> EoT at head
                self.open()
                return out

    def peek(self) -> T:
        """Blocking peek: return the head token without consuming it.

        The channel state is unchanged (paper Section 3.1.2)."""
        c = self._chan
        rt = _rt()
        while c.is_empty():
            rt.wait(c, READABLE)
        tok = c._head()
        if tok is EOT:
            raise EndOfTransaction(
                f"peek() found EoT on channel {c.name!r}")
        return tok

    def eot(self) -> bool:
        """Blocking: wait for a token, return whether it is EoT (no consume)."""
        c = self._chan
        rt = _rt()
        while c.is_empty():
            rt.wait(c, READABLE)
        return c._head() is EOT

    def open(self) -> None:
        """Blocking read of an EoT token ("open" the channel for the next
        transaction).  Errors if the head token carries data."""
        c = self._chan
        rt = _rt()
        while c.is_empty():
            rt.wait(c, READABLE)
        if rt.fast_path and not c._wwait:
            tok = c._pop()
        else:
            tok = rt.pop(c)
        if tok is not EOT:
            raise ChannelMisuse(
                f"open() expected EoT on channel {c.name!r}, got data")

    # -- non-blocking ops --------------------------------------------------
    def try_read(self) -> tuple[bool, Optional[T]]:
        c = self._chan
        rt = _rt()
        q = c._q
        if not q or q[0] is EOT:
            return False, None
        if rt.fast_path and not c._wwait:
            return True, q.popleft()
        return True, rt.pop(c)

    def try_read_burst(self, n: int) -> list:
        """Non-blocking burst read: consume and return the up-to-``n`` data
        tokens available right now (empty list when none, or when the head
        is EoT)."""
        if n < 0:
            raise ValueError("try_read_burst size must be >= 0")
        c = self._chan
        rt = _rt()
        k = c._data_run(n) if rt.fast_path else rt.data_run(c, n)
        if k == 0:
            return []
        q = c._q
        if rt.fast_path and not c._wwait:
            return [q.popleft() for _ in range(k)]
        return rt.pop_burst(c, k)

    def try_peek(self) -> tuple[bool, Optional[T]]:
        c = self._chan
        if c.is_empty() or c._head() is EOT:
            return False, None
        return True, c._head()

    def try_eot(self) -> tuple[bool, bool]:
        """Returns (token_available, head_is_eot)."""
        c = self._chan
        if c.is_empty():
            return False, False
        return True, c._head() is EOT

    def try_open(self) -> bool:
        c = self._chan
        rt = _rt()
        if c.is_empty() or c._head() is not EOT:
            return False
        if rt.fast_path and not c._wwait:
            c._pop()
        else:
            rt.pop(c)
        return True

    # -- iteration sugar: drain one transaction ----------------------------
    def __iter__(self):
        """Iterate over the tokens of one transaction, then consume its EoT.

        ``for x in stream: ...`` is the idiomatic replacement for the
        paper's Listing-2 loop ``while (!in.eot()) { v = in.read(); ... }``.
        """
        while not self.eot():
            yield self.read()
        self.open()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"IStream({self._chan.name!r})"


class OStream(Generic[T]):
    """Producer-side view of a channel (paper Table 2 + burst extension)."""

    __slots__ = ("_chan",)

    def __init__(self, chan: Channel):
        self._chan = chan

    @property
    def channel(self) -> Channel:
        return self._chan

    def full(self) -> bool:
        return self._chan.is_full()

    def write(self, v: T) -> None:
        """Blocking write of a data token."""
        if v is EOT:
            raise ChannelMisuse("use close() to send EoT")
        c = self._chan
        rt = _rt()
        q = c._q
        if rt.fast_path and len(q) < c.capacity and not c._rwait:
            # run-to-block fast path: space available, no parked reader to
            # wake — enqueue without entering the engine
            q.append(v)
            return
        while c.is_full():
            rt.wait(c, WRITABLE)
        rt.push(c, v)

    def write_burst(self, seq: Sequence[T]) -> None:
        """Blocking burst write of every token in ``seq``, in order.

        Equivalent to scalar ``write()`` per token, but tokens move in
        capacity-sized batches (``deque.extend``) and the runtime is
        entered once per batch — or not at all when the channel has room
        and no parked reader.  Capacity is still honored exactly: a batch
        never exceeds the free slots, and the call blocks between batches
        when the channel is full.
        """
        toks = list(seq)
        for v in toks:
            if v is EOT:
                raise ChannelMisuse("use close() to send EoT")
        c = self._chan
        rt = _rt()
        q = c._q
        i, n = 0, len(toks)
        while i < n:
            room = c.capacity - len(q)
            if room <= 0:
                rt.wait(c, WRITABLE)
                continue
            j = min(i + room, n)
            if rt.fast_path and not c._rwait:
                q.extend(toks[i:j])
            else:
                rt.push_burst(c, toks[i:j])
            i = j

    def close(self) -> None:
        """Blocking write of an EoT token ("close" the transaction)."""
        c = self._chan
        rt = _rt()
        if rt.fast_path and len(c._q) < c.capacity and not c._rwait:
            c._push(EOT)
            return
        while c.is_full():
            rt.wait(c, WRITABLE)
        rt.push(c, EOT)

    def try_write(self, v: T) -> bool:
        if v is EOT:
            raise ChannelMisuse("use close() to send EoT")
        c = self._chan
        rt = _rt()
        if c.is_full():
            return False
        if rt.fast_path and not c._rwait:
            c._q.append(v)
            return True
        rt.push(c, v)
        return True

    def try_write_burst(self, seq: Sequence[T]) -> int:
        """Non-blocking burst write: enqueue as many leading tokens of
        ``seq`` as fit right now; returns the number written."""
        toks = list(seq)
        for v in toks:
            if v is EOT:
                raise ChannelMisuse("use close() to send EoT")
        c = self._chan
        rt = _rt()
        k = min(c.capacity - len(c._q), len(toks))
        if k <= 0:
            return 0
        if rt.fast_path and not c._rwait:
            c._q.extend(toks[:k])
        else:
            rt.push_burst(c, toks[:k])
        return k

    def try_close(self) -> bool:
        c = self._chan
        rt = _rt()
        if c.is_full():
            return False
        if rt.fast_path and not c._rwait:
            c._push(EOT)
            return True
        rt.push(c, EOT)
        return True

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"OStream({self._chan.name!r})"


def channel(capacity: int = 2, name: Optional[str] = None,
            dtype: Any = None, shape: Optional[tuple] = None) -> Channel:
    """Instantiate a channel — ``tapa::channel<T, capacity>`` (Listing 5).

    ``dtype``/``shape`` declare the element spec (the ``T``): engines
    enforce it on every push under ``track_stats``, and synthesis
    (:mod:`repro_torch.core.synth`) requires it to size the on-device ring
    buffer."""
    return Channel(capacity=capacity, name=name, dtype=dtype, shape=shape)


def select(*streams) -> None:
    """Block until at least one stream can make progress.

    IStream arguments wait for a readable token (data *or* EoT); OStream
    arguments wait for writable space.  This is the multi-port polling
    primitive hardware switch elements have for free (combinational
    ready/valid over all ports) and that strict KPN forbids — the paper's
    "we are not limited to KPN" extension point (Section 2.2).  Without it,
    a cooperative simulator livelocks on availability-routed designs such
    as the Omega switch: a task that must watch two inputs and two outputs
    cannot commit to blocking on any single one.

    Returns immediately if any stream is already ready.
    """
    keys = []
    for s in streams:
        if isinstance(s, IStream):
            keys.append((s.channel, READABLE))
        elif isinstance(s, OStream):
            keys.append((s.channel, WRITABLE))
        else:   # AutoStream or raw channel: direction by bound view
            chan = getattr(s, "channel", s)
            view = getattr(s, "_view", None)
            side = WRITABLE if isinstance(view, OStream) else READABLE
            keys.append((chan, side))
    for chan, side in keys:
        ok = (not chan.is_empty()) if side == READABLE else \
            (not chan.is_full())
        if ok:
            return
    _rt().wait_many(keys)
