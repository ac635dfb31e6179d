"""Small versions of the cells, for CPU tests: the configurations' widths
kept, the images and the traffic shrunk."""
from bench_port import spec


def small_cell(name: str, **mix_over):
    """``(config, mix)`` of cell ``name`` at a size a CPU test can run."""
    wl = spec.workload(name)
    cfg = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    if cfg["engine"] == "visual":
        cfg = dict(cfg, image_size=32)
    if mix["generator"] == "closed_bulk":
        lengths = {"visual": [2, 4], "audio": [3000, 5000]}[cfg["engine"]]
        mix = dict(mix, clips_per_call=8, pool=2, lengths=lengths)
    mix.update(mix_over)
    return cfg, mix
