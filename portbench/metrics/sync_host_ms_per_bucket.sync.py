"""sync_host_ms_per_bucket.sync: host ms from the call of the gradient
sync to its return, before the device is waited for, a bucket: the mean
over the traced run's steps that follow its profiled ones, each started on
an idle device, over the buckets (host clock)."""


def read(run):
    tr = run["trace"]
    host = tr.get("host_sync_s") if tr else None
    if not host:
        return None
    return 1e3 * sum(host) / len(host) / tr["buckets"]
