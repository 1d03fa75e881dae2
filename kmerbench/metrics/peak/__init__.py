"""`peak.<metric>`: the reader `<metric>` under a name of its own, for the
cells whose wall rate holds no bound (`bases_per_s` is end to end only
where its runs repeat closely enough): there a per-layer metric has to
name another end-to-end metric that the cell reports, `peak_device_gib`."""
