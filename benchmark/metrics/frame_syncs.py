"""Host-device synchronisations per frame inside the port's ``vt.frame``
(torch's sync-debug mode and ``torch.cuda.synchronize``, counted by the
program under the stage that made them), the mean over the CUDA frames
the program recorded. None in a run with no device trace (the CPU's),
where the program has no recorder, or where it holds nothing."""

from .frame_host_ms import recorder


def read(run):
    rec = recorder(run)
    return None if rec is None else rec.frame_syncs()
