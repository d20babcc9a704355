"""File-backed datasources (port of
``sentinel_tpu/datasource/file_source.py``).

Reference: FileRefreshableDataSource.java:39 (poll by last-modified
time) and FileWritableDataSource.java:33 (serialize + overwrite).
Together with WritableDataSourceRegistry they give rule persistence:
dashboard pushes rules → command handler writes the file → the
refreshable source picks it up on every process, including restarts.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional

from sentinel_tpu_torch.datasource.base import (
    AutoRefreshDataSource,
    Converter,
    WritableDataSource,
)


class FileRefreshableDataSource(AutoRefreshDataSource[str, List]):
    def __init__(
        self,
        file_path: str,
        converter: Converter[str, List],
        refresh_interval_sec: float = 3.0,
        charset: str = "utf-8",
    ) -> None:
        super().__init__(converter, refresh_interval_sec)
        self.file_path = os.path.abspath(file_path)
        self.charset = charset
        self._last_modified = 0.0

    def is_modified(self) -> bool:
        try:
            mtime = os.path.getmtime(self.file_path)
        except OSError:
            return False
        if mtime != self._last_modified:
            self._last_modified = mtime
            return True
        return False

    def read_source(self) -> Optional[str]:
        try:
            with open(self.file_path, "r", encoding=self.charset) as f:
                return f.read()
        except OSError:
            return None


class FileWritableDataSource(WritableDataSource):
    def __init__(
        self,
        file_path: str,
        encoder: Callable[[object], str],
        charset: str = "utf-8",
    ) -> None:
        self.file_path = os.path.abspath(file_path)
        self.encoder = encoder
        self.charset = charset
        self._lock = threading.Lock()

    def write(self, value) -> None:
        text = self.encoder(value)
        with self._lock:
            os.makedirs(os.path.dirname(self.file_path) or ".", exist_ok=True)
            with open(self.file_path, "w", encoding=self.charset) as f:
                f.write(text)
