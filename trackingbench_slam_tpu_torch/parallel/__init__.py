"""Many sequences on one card (dp_eval) and landmark-sharded windowed BA
over torch.distributed (dist_ba, mesh, multihost)."""
