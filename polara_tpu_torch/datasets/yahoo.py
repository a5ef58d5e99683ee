"""Yahoo! Music loader (host copy of :mod:`polara_tpu.datasets.yahoo`;
reference ``polara/datasets/yahoo.py:4-35``).  pandas loads on the first
call."""
from __future__ import annotations

import tarfile

DATA_FOLDER = "ydata-ymusic-user-song-ratings-meta-v1_0"


def get_yahoo_music_data(path=None, fileid: int = 0,
                         include_test: bool = True,
                         read_attributes: bool = False,
                         read_genres: bool = False):
    """Parse the user-song-ratings tarball: train/test rating splits plus
    optional song attributes and the genre hierarchy."""
    import pandas as pd

    res = []
    if path:
        col_names = ["userid", "songid", "rating"]
        with tarfile.open(path, "r:gz") as tar:
            def read_member(name, **kwargs):
                handle = tar.extractfile(tar.getmember(
                    f"{DATA_FOLDER}/{name}"))
                return pd.read_csv(handle, sep="\t", header=None, **kwargs)

            res.append(read_member(f"train_{fileid}.txt", names=col_names))
            if include_test:
                res.append(read_member(f"test_{fileid}.txt",
                                       names=col_names))
            if read_attributes:
                res.append(read_member(
                    "song-attributes.txt", index_col=0,
                    names=["songid", "albumid", "artistid", "genreid"]))
            if read_genres:
                res.append(read_member(
                    "genre-hierarchy.txt", index_col=0,
                    names=["genreid", "parent_genre", "level",
                           "genre_name"]))
    return res[0] if len(res) == 1 else res
