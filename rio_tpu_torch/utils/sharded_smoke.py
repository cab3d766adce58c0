"""``python -m rio_tpu_torch.sharded --smoke``, its node's SQLite files made first.

    python -m rio_tpu_torch.utils.sharded_smoke [--shard-aware]

The smoke's two workers open the node's fresh membership and directory files
together, and a switch to WAL that meets a peer's write lock fails at once,
busy timeout or not: the worker exits during bring-up (the reference's
``utils/sqlite.py`` and its copy alike). This runs the same command line with
each node's files made in this process before its workers start, as
``rio_tpu_torch.bench.prepare_node_storage`` does for the bench's nodes.
"""

from __future__ import annotations

import sys


def main(argv: list[str]) -> int:
    from .. import sharded
    from ..bench import prepare_node_storage

    start = sharded.ShardedServer.start

    def start_on_prepared_files(self):
        prepare_node_storage(self.data_dir)
        return start(self)

    sharded.ShardedServer.start = start_on_prepared_files
    sys.argv = ["rio_tpu_torch.sharded", "--smoke", *argv]
    try:
        return sharded._main()
    finally:
        sharded.ShardedServer.start = start


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
