"""Seconds of the host table passes per FOV over the window's jobs (host
code): run_pixel_clustering's som_avg_s + meta_avg_s + final_write_s."""


def read(rec):
    if not rec.get("fovs"):
        return None
    return rec["table_s"] / rec["fovs"]
