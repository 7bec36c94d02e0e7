"""Reader combinators — the host-side data pipeline (counterpart of
``paddle_tpu.data.reader``, copied: the module imports neither JAX nor
torch).

Analog of python/paddle/reader/decorator.py:36-338 (map_readers/
shuffle/chain/compose/buffered/firstn/xmap_readers/cache) and
fluid.layers.io batching. A *reader creator* is a zero-arg callable
returning an iterator of samples, exactly the reference's convention, so
user code ports 1:1. The device-feeding end lives in
paddle_tpu_torch.data.feeder.
"""

from __future__ import annotations

import itertools
import queue as _queue
import random as _random
import threading
from typing import Any, Callable, Iterator, List

Reader = Callable[[], Iterator[Any]]


def map_readers(func: Callable, *readers: Reader) -> Reader:
    """Apply func elementwise over zipped readers (decorator.py:36)."""

    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return reader


def shuffle(reader: Reader, buf_size: int, seed: int = None) -> Reader:
    """Shuffle within a sliding buffer (decorator.py:~120)."""

    def new_reader():
        rnd = _random.Random(seed)
        buf: List[Any] = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                rnd.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rnd.shuffle(buf)
            yield from buf

    return new_reader


def chain(*readers: Reader) -> Reader:
    """Concatenate readers (decorator.py chain)."""

    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers: Reader, check_alignment: bool = True) -> Reader:
    """Zip readers into tuple samples (decorator.py compose)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    _miss = object()

    def reader():
        its = [r() for r in readers]
        if not check_alignment:
            for items in zip(*its):
                yield sum((make_tuple(i) for i in items), ())
            return
        for items in itertools.zip_longest(*its, fillvalue=_miss):
            if any(i is _miss for i in items):
                raise ComposeNotAligned(
                    "compose: input readers yielded different lengths")
            yield sum((make_tuple(i) for i in items), ())

    return reader


def buffered(reader: Reader, size: int) -> Reader:
    """Read ahead in a daemon thread (decorator.py buffered) — overlaps
    host IO with device compute."""

    class _End:
        pass

    def new_reader():
        q: _queue.Queue = _queue.Queue(maxsize=size)

        def fill():
            try:
                for d in reader():
                    q.put(d)
            finally:
                q.put(_End)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e

    return new_reader


def firstn(reader: Reader, n: int) -> Reader:
    def new_reader():
        yield from itertools.islice(reader(), n)

    return new_reader


def cache(reader: Reader) -> Reader:
    """Materialize once, replay from memory (decorator.py cache)."""
    data: List[Any] = []
    filled = [False]

    def new_reader():
        if not filled[0]:
            data.extend(reader())
            filled[0] = True
        yield from data

    return new_reader


def xmap_readers(mapper: Callable, reader: Reader, process_num: int,
                 buffer_size: int, order: bool = False) -> Reader:
    """Parallel map via worker threads (decorator.py:~250 xmap_readers).
    Threads (not processes) suffice here: host-side decode work releases
    the GIL in numpy, and device feeding is the bottleneck anyway."""

    class _End:
        pass

    def new_reader():
        in_q: _queue.Queue = _queue.Queue(buffer_size)
        out_q: _queue.Queue = _queue.Queue(buffer_size)

        def feed():
            for i, d in enumerate(reader()):
                in_q.put((i, d))
            for _ in range(process_num):
                in_q.put(_End)

        def work():
            while True:
                e = in_q.get()
                if e is _End:
                    out_q.put(_End)
                    break
                i, d = e
                out_q.put((i, mapper(d)))

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        done = 0
        if order:
            pending = {}
            nxt = 0
            while done < process_num:
                e = out_q.get()
                if e is _End:
                    done += 1
                    continue
                i, d = e
                pending[i] = d
                while nxt in pending:
                    yield pending.pop(nxt)
                    nxt += 1
            while nxt in pending:
                yield pending.pop(nxt)
                nxt += 1
        else:
            while done < process_num:
                e = out_q.get()
                if e is _End:
                    done += 1
                    continue
                yield e[1]

    return new_reader


def batch(reader: Reader, batch_size: int, drop_last: bool = True) -> Reader:
    """Group samples into lists (paddle.batch analog). drop_last defaults
    True, as in the JAX package, so every batch has one shape."""

    def new_reader():
        b = []
        for s in reader():
            b.append(s)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return new_reader


class ComposeNotAligned(ValueError):
    """reader/decorator.py ComposeNotAligned: compose() inputs yielded
    different lengths."""


def fake(reader, n: int = 1):
    """decorator.py Fake: cache the first sample and replay it ``n``
    times — the input-pipeline-removal benchmark trick."""
    def _r():
        it = iter(reader())
        try:
            cached = next(it)
        except StopIteration:
            raise ValueError("fake(): source reader is empty") from None
        for _ in range(n):
            yield cached
    return _r


Fake = fake


class PipeReader:
    """decorator.py PipeReader: stream samples from a shell command's
    stdout (e.g. zcat / hadoop fs -cat), split on a delimiter."""

    def __init__(self, command: str, bufsize: int = 8192, file_type: str = "plain"):
        import subprocess
        if file_type not in ("plain", "gzip"):
            raise ValueError(f"PipeReader: unsupported file_type {file_type!r}")
        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type
        self.process = subprocess.Popen(
            command.split(" "), bufsize=bufsize, stdout=subprocess.PIPE)

    def get_line(self, cut_lines: bool = True, line_break: str = "\n"):
        import zlib
        decomp = zlib.decompressobj(32 + zlib.MAX_WBITS) \
            if self.file_type == "gzip" else None
        remained = ""
        while True:
            buff = self.process.stdout.read(self.bufsize)
            if not buff:
                if decomp is not None:
                    tail = decomp.flush()
                    if tail:
                        remained += tail.decode("utf-8", errors="replace")
                break
            if decomp is not None:
                out = decomp.decompress(buff)
                # concatenated gzip members (cat a.gz b.gz): restart the
                # stream on each member boundary or data after the first
                # member is silently dropped
                while decomp.eof and decomp.unused_data:
                    rest = decomp.unused_data
                    decomp = zlib.decompressobj(32 + zlib.MAX_WBITS)
                    out += decomp.decompress(rest)
                buff = out
            buff = buff.decode("utf-8", errors="replace")
            if cut_lines:
                lines = (remained + buff).split(line_break)
                remained = lines.pop(-1)
                for line in lines:
                    yield line
            else:
                yield buff
        if remained:
            yield remained


def multiprocess_reader(readers, use_pipe: bool = True, queue_size: int = 1000):
    """decorator.py multiprocess_reader: run N readers in workers, merge
    into one stream. Thread-based (workers are IO-bound; a fork would copy
    the CUDA context; ``use_pipe`` is accepted for API parity — both
    reference transports map to the same queue here). Worker exceptions
    are re-raised in the consumer."""
    import queue as _q

    def _r():
        q: _q.Queue = _q.Queue(maxsize=queue_size)
        _sentinel = object()

        def work(r):
            try:
                for sample in r():
                    q.put(sample)
                q.put(_sentinel)
            except BaseException as e:  # propagate to the consumer
                q.put(_WorkerError(e))

        ts = [threading.Thread(target=work, args=(r,), daemon=True) for r in readers]
        for t in ts:
            t.start()
        done = 0
        while done < len(readers):
            item = q.get()
            if item is _sentinel:
                done += 1
            elif isinstance(item, _WorkerError):
                raise item.error
            else:
                yield item
    return _r


class _WorkerError:
    def __init__(self, error: BaseException):
        self.error = error
