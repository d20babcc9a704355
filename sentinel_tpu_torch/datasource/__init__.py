"""Dynamic rule datasources (port of ``sentinel_tpu/datasource``).

The equivalent of sentinel-datasource-extension (sentinel-extension/
sentinel-datasource-extension/.../datasource/ReadableDataSource.java:28-44,
AbstractDataSource.java:29-48, AutoRefreshDataSource.java:32-69,
FileRefreshableDataSource.java:39, FileWritableDataSource.java:33): a
datasource adapts an external config store to a SentinelProperty that the
rule managers listen on. Here: the base classes
(:mod:`~sentinel_tpu_torch.datasource.base`: the polling and push bases,
the in-memory source and the writable registry the ``setRules`` command
writes through), the file sources
(:mod:`~sentinel_tpu_torch.datasource.file_source`) and the shared retry
backoff (:mod:`~sentinel_tpu_torch.datasource.backoff`, which the engine
supervisor and the cluster client use). The network sources of the JAX
package (Redis, etcd, Consul, Nacos, ZooKeeper, Apollo, Eureka, the Config
Server and HTTP) are ROADMAP Queue 1 item 11.
"""

from sentinel_tpu_torch.datasource.base import (
    AbstractDataSource,
    AutoRefreshDataSource,
    Converter,
    InMemoryDataSource,
    PushDataSource,
    ReadableDataSource,
    WritableDataSource,
    WritableDataSourceRegistry,
    json_converter,
)
from sentinel_tpu_torch.datasource.file_source import (
    FileRefreshableDataSource,
    FileWritableDataSource,
)

__all__ = [
    "AbstractDataSource",
    "AutoRefreshDataSource",
    "Converter",
    "InMemoryDataSource",
    "PushDataSource",
    "ReadableDataSource",
    "WritableDataSource",
    "WritableDataSourceRegistry",
    "json_converter",
    "FileRefreshableDataSource",
    "FileWritableDataSource",
]
