"""Netflix Prize loader (host copy of :mod:`polara_tpu.datasets.netflix`;
reference ``polara/datasets/netflix.py:5-46``).

The official release nests a per-movie-file tar inside the outer archive;
the loader streams every inner member into one DataFrame without unpacking
to disk.  pandas loads on the first call.
"""
from __future__ import annotations

import tarfile


def get_netflix_data(gz_file, get_ratings: bool = True,
                     get_probe: bool = False):
    """Parse the Netflix Prize archive.

    Returns the ratings frame (movieid/userid/rating), the probe frame,
    or a tuple of both.
    """
    import pandas as pd

    movie_data = []
    movie_inds = []
    probe = []
    with tarfile.open(gz_file) as tar:
        if get_ratings:
            training_data = tar.getmember("download/training_set.tar")
            with tarfile.open(fileobj=tar.extractfile(training_data)) as inn:
                for item in inn.getmembers():
                    if not item.isfile():
                        continue
                    handle = inn.extractfile(item.name)
                    frame = pd.read_csv(handle)
                    movieid = frame.columns[0]
                    movie_inds.append(int(movieid[:-1]))
                    movie_data.append(frame[movieid])

        if get_probe:
            probe_data = tar.getmember("download/probe.txt")
            probe_file = tar.extractfile(probe_data)
            movieid = None
            for line in probe_file:
                line = line.strip()
                if line.endswith(b":"):
                    movieid = int(line[:-1])
                else:
                    probe.append((movieid, int(line)))

    data = None
    if movie_data:
        data = pd.concat(movie_data, keys=movie_inds)
        data = (data.reset_index().iloc[:, :3]
                .rename(columns={"level_0": "movieid",
                                 "level_1": "userid",
                                 "level_2": "rating"}))
    if get_probe:
        probe = pd.DataFrame.from_records(probe,
                                          columns=["movieid", "userid"])
        data = (data, probe) if data is not None else probe
    return data
