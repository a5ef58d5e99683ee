"""MovieLens loaders (host copy of :mod:`polara_tpu.datasets.movielens`;
reference ``polara/datasets/movielens.py:11-102``).

Handles both the classic ``::``-delimited archives (ml-1m, ml-10m) and the
newer comma-separated ones (ml-latest, ml-20m) from a local zip file or
the bytes :func:`fetch_url` reads.  pandas loads on the first call, so the
package imports without it.
"""
from __future__ import annotations

from io import BytesIO
from zipfile import ZipFile

import numpy as np

ML1M_URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"


def fetch_url(url: str) -> BytesIO:
    """The bytes behind ``url`` in memory (``file://`` URLs read local
    files; other schemes need network access)."""
    from urllib.request import urlopen
    with urlopen(url) as response:
        return BytesIO(response.read())


def _read_legacy_csv(raw: bytes, names, delimiter: str = "^", header=None,
                     encoding: str = "unicode_escape", usecols=None):
    """Old-format files use the 2-char ``::`` separator; rewrite it to a
    single-char one so the fast pandas C engine applies (the python
    engine is an order of magnitude slower at ML-10M size)."""
    import pandas as pd
    raw = raw.replace(b"::", delimiter.encode())
    return pd.read_csv(BytesIO(raw), sep=delimiter, header=header,
                       engine="c", encoding=encoding, names=names,
                       usecols=usecols)


def get_movielens_data(local_file=None, get_ratings: bool = True,
                       get_genres: bool = False, split_genres: bool = True,
                       mdb_mapping: bool = False, get_tags: bool = False,
                       include_time: bool = False,
                       allow_download: bool = False):
    """Load MovieLens ratings (and optionally genres/tags/links) into
    DataFrames from a local zip path/handle (e.g. :func:`fetch_url`'s).

    With no ``local_file`` and ``allow_download=True`` the ml-1m archive is
    fetched from grouplens.org.
    """
    import pandas as pd

    fields = ["userid", "movieid", "rating"]
    if include_time:
        fields.append("timestamp")

    if local_file is None:
        if not allow_download:
            raise ValueError("no local_file given; pass allow_download=True "
                             "to fetch ml-1m from grouplens.org")
        zip_contents = fetch_url(ML1M_URL)
    else:
        zip_contents = local_file

    ml_data = ml_genres = ml_tags = mapping = None
    with ZipFile(zip_contents) as zfile:
        zip_files = pd.Series(zfile.namelist())
        ratings_file = zip_files[zip_files.str.contains("ratings")].iat[0]
        is_new_format = ("latest" in ratings_file) or ("20m" in ratings_file)

        if get_ratings:
            raw = zfile.read(ratings_file)
            if is_new_format:
                ml_data = pd.read_csv(BytesIO(raw), sep=",", header=0,
                                      engine="c", names=fields,
                                      usecols=fields)
            else:
                ml_data = _read_legacy_csv(raw, fields, delimiter=",",
                                           encoding=None, usecols=fields)

        if get_genres:
            movies_file = zip_files[zip_files.str.contains("movies")].iat[0]
            raw = zfile.read(movies_file)
            names = ["movieid", "movienm", "genres"]
            if is_new_format:
                genres_data = pd.read_csv(BytesIO(raw), sep=",", header=0,
                                          engine="c", names=names)
            else:
                genres_data = _read_legacy_csv(raw, names)
            ml_genres = (get_split_genres(genres_data) if split_genres
                         else genres_data)

        if get_tags:
            tags_file = zip_files[zip_files.str.contains("/tags")].iat[0]
            raw = zfile.read(tags_file)
            tag_fields = fields[:2] + ["tag"] + fields[3:]
            if is_new_format:
                ml_tags = pd.read_csv(BytesIO(raw), sep=",", header=0,
                                      engine="c", names=tag_fields,
                                      usecols=range(len(tag_fields)))
            else:
                ml_tags = _read_legacy_csv(raw, tag_fields,
                                           encoding="latin1",
                                           usecols=range(len(tag_fields)))

        if mdb_mapping and is_new_format:
            links_file = zip_files[zip_files.str.contains("links")].iat[0]
            with zfile.open(links_file) as zdata:
                mapping = pd.read_csv(zdata, sep=",", header=0, engine="c",
                                      names=["movieid", "imdbid", "tmdbid"])

    res = [d for d in (ml_data, ml_genres, ml_tags, mapping) if d is not None]
    return res[0] if len(res) == 1 else res


def get_split_genres(genres_data):
    """Explode the ``|``-separated genre strings of a
    ``movieid/movienm/genres`` frame into one row per (movie, genre) pair
    (reference ``movielens.py:86-94``)."""
    exploded = genres_data.assign(
        genreid=genres_data["genres"].str.split("|"))
    exploded = exploded.explode("genreid", ignore_index=True)
    return exploded[["movieid", "movienm", "genreid"]]


def filter_short_head(data, threshold: float = 0.01):
    """Return the long-tail movie ids (a pandas Index): drop the
    most-popular movies that jointly account for the top ``threshold``
    fraction of the catalog (reference ``movielens.py:97-102``)."""
    short_head = data.groupby("movieid", sort=False)["userid"].nunique()
    short_head = short_head.sort_values(ascending=False)
    ratings_perc = short_head.cumsum() * 1.0 / short_head.sum()
    movies_perc = (np.arange(1, len(short_head) + 1, dtype="f8")
                   / len(short_head))
    return ratings_perc[movies_perc > threshold].index
