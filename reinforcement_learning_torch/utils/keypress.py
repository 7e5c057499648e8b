"""Keyboard 'save and quit' detector (Util/KeyPressDetector.{h,cpp} and
the learner's quit-key thread, Learner.cpp:281-298): pressing 'Q' asks for
a final checkpoint and a clean exit.  A daemon thread polls stdin in
cbreak mode; ``pressed()`` goes to ``Trainer.train(stop_fn=...)``.
Without a terminal on stdin the detector is inert.  The port's own copy of
the JAX package's module.
"""

from __future__ import annotations

import sys
import threading


class KeyPressDetector:
    def __init__(self, keys: str = "qQ"):
        self._keys = set(keys)
        self._hit = threading.Event()
        self._thread = None
        if sys.stdin is not None and sys.stdin.isatty():
            self._thread = threading.Thread(target=self._poll, daemon=True)
            self._thread.start()

    def _poll(self):
        try:
            import termios
            import tty

            fd = sys.stdin.fileno()
            old = termios.tcgetattr(fd)
            try:
                tty.setcbreak(fd)
                while not self._hit.is_set():
                    ch = sys.stdin.read(1)
                    if ch in self._keys:
                        self._hit.set()
            finally:
                termios.tcsetattr(fd, termios.TCSADRAIN, old)
        except Exception:
            pass  # non-tty / restricted environment: detector is inert

    def pressed(self) -> bool:
        return self._hit.is_set()
