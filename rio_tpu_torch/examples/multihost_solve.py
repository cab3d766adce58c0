"""Multi-process placement solve on the port: the same program from 1 process to N.

The twin of ``examples/multihost_solve.py`` on ``torch.distributed``
(:mod:`rio_tpu_torch.parallel.multihost`). The program text is the same
for one process and for N:

1. One process (8 shards of one device)::

       python -m rio_tpu_torch.examples.multihost_solve [--device cpu]

2. Two processes on one machine, over loopback (gloo on the CPU, NCCL on
   CUDA devices)::

       python -m rio_tpu_torch.examples.multihost_solve --coordinator 127.0.0.1:9911 \\
           --num-processes 2 --process-id 0 --device cpu &
       python -m rio_tpu_torch.examples.multihost_solve --coordinator 127.0.0.1:9911 \\
           --num-processes 2 --process-id 1 --device cpu

:func:`multihost.initialize` joins the processes into one group; the mesh
spans 8 shards in all (``8 // processes`` of this process's device each,
as the reference's single-process run has 8 virtual CPU devices), and
``sharded_hierarchical_assign`` solves every shard's rows against its share
of each node's capacity. Every process draws the same global inputs from
``PRNGKey(0)`` (:mod:`rio_tpu_torch.ops.prng`, the reference's own draws)
and feeds only its rows. Node 5 is dead; the run asserts that it holds
nothing and that nothing overflowed.
"""

from __future__ import annotations

import argparse

MESH_SHARDS = 8  # the reference's single-process demo: 8 virtual CPU devices
N_FEAT, N_NODES, N_GROUPS, DEAD_NODE = 16, 64, 8, 5


def main(argv: list[str] | None = None) -> dict:
    """Run the solve; print the reference's lines; return the outcome on this process."""
    ap = argparse.ArgumentParser(prog="python -m rio_tpu_torch.examples.multihost_solve")
    ap.add_argument("--coordinator", default=None, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--objects-per-device", type=int, default=4096)
    ap.add_argument("--device", default=None, help="this process's device (CUDA when not given)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..device import resolve_device
    from ..ops import prng
    from ..parallel import make_mesh, multihost
    from ..parallel.hierarchical import sharded_hierarchical_assign
    from ..parallel.mesh import group_up

    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    was_up = group_up()
    multi = multihost.initialize(
        args.coordinator, args.num_processes, args.process_id,
        local_device_ids=[dev.index] if dev.type == "cuda" else None,
        backend="gloo" if dev.type == "cpu" else None,
    )
    joined = group_up() and not was_up  # a group this run brought up, and so leaves
    try:
        world = dist.get_world_size() if group_up() else 1
        me = dist.get_rank() if group_up() else 0
        mesh = make_mesh([dev] * max(1, MESH_SHARDS // world))  # spans every process's shards
        n_shards = int(mesh.devices.size)
        print(
            f"[host {me}] processes={world} global_devices={n_shards} "
            f"local={len(mesh.local_cells)} (multihost={multi})"
        )

        n_obj = args.objects_per_device * n_shards
        d, m, g = N_FEAT, N_NODES, N_GROUPS
        k1, k2 = prng.split(prng.prng_key(0, dev))
        # Every process derives the same global inputs, then feeds ONLY its rows.
        obj_all = prng.normal_of(k1, (n_obj, d))
        node_feat = prng.normal_of(k2, (d, m)) * 0.2
        rows = multihost.process_rows(n_obj, mesh)
        axes = tuple(mesh.axis_names)
        obj_feat = multihost.distributed_array(mesh, (axes, None), obj_all[rows])
        cap = torch.ones(m, dtype=torch.float32, device=dev)
        alive = torch.ones(m, dtype=torch.float32, device=dev)
        alive[DEAD_NODE] = 0.0  # one dead node

        res = sharded_hierarchical_assign(mesh, obj_feat, node_feat, cap, alive, n_groups=g)
        if world > 1:
            # Each process's own rows, gathered in rank order.
            mine = res.assignment[rows].contiguous()
            parts = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(parts, mine)
            a = torch.cat(parts)
        else:
            a = res.assignment
        loads = torch.bincount(a.long(), minlength=m).cpu()
        overflow = int(res.overflow)
        outcome = {
            "process": me,
            "processes": world,
            "n_obj": n_obj,
            "live_nodes": m - 1,
            "load_min": int(loads[loads > 0].min()),
            "load_max": int(loads.max()),
            "dead_node_load": int(loads[DEAD_NODE]),
            "overflow": overflow,
        }
        print(
            f"[host {me}] placed {n_obj} objects on {m - 1} live nodes: "
            f"load min/max = {outcome['load_min']}/{outcome['load_max']}, "
            f"dead-node load = {outcome['dead_node_load']}, overflow = {overflow}"
        )
        assert outcome["dead_node_load"] == 0 and overflow == 0
        return outcome
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
