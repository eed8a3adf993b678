"""The synchronizing CUDA calls of one collect phase, counted by
``torch.cuda.set_sync_debug_mode("warn")``; nothing off the card."""


def read(data):
    return data["host_syncs_collect"]
