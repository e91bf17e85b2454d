"""flash_fwd_roofline (%): the least time of the window's attention
forwards over the device time of the flash forward kernel
(``kernels/flash_attention``, ``flash_fwd``). A round runs each client's
tau forwards under grad (with the rows' logsumexp) and, where the round
evaluates, one of the global loss, each attention layer once; the least
time of a call is ``counts.flash_call`` at the chip's peaks."""
from fl_bench import counts, families, jobs, peaks

KERNEL = r"\bflash_fwd\b"


def read(r):
    if r.device is None:
        return None
    seconds = r.device.seconds(KERNEL)
    if not seconds:
        return None
    t, spec = r.traffic, r.traffic["spec"]
    job = jobs.load(t["job"])
    evals = sum(job.evaluates(spec, k, len(j.history)) for j in r.jobs
                for k in range(len(j.history)))
    per_client = families.load(r.widths["family"]).attention_layers(
        r.widths) * spec["n_clients"]
    train = peaks.least_seconds(*counts.flash_call(r.widths, t, False, True))
    ev = peaks.least_seconds(*counts.flash_call(r.widths, t, False, False))
    least = per_client * (r.rounds * spec["tau"] * train + evals * ev)
    return 100.0 * least / seconds
