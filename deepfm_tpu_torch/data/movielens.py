"""MovieLens-100K adapter: fully vectorized host data pipeline.

The port's own copy of ``deepfm_tpu/data/movielens.py``: the same 16-field
schema, feature engineering, split protocols and negative sampling, so a
given seed yields the same packed arrays as the JAX package's adapter
with the same ``data.use_native_sampler``. With it on (the default) the
negatives come from the port's native sampler (``native/sampler.py``,
built with g++ at first use; a build that fails raises), which takes its
seed from the adapter's RNG where the JAX adapter takes it; with it off,
from the numpy sampler.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deepfm_tpu_torch.config import DataConfig
from deepfm_tpu_torch.data.dataset import TabularDataset
from deepfm_tpu_torch.data.schema import DatasetSchema, FeatureType, FieldSchema
from deepfm_tpu_torch.data.transforms import LabelEncoder, MinMaxScaler, MultiHotEncoder

GENRE_NAMES = [
    "unknown", "Action", "Adventure", "Animation", "Children's", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror",
    "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]

AGE_BUCKETS = np.array([1, 18, 25, 35, 45, 50, 56], np.int64)

_MONTHS = {
    "Jan": 1, "Feb": 2, "Mar": 3, "Apr": 4, "May": 5, "Jun": 6,
    "Jul": 7, "Aug": 8, "Sep": 9, "Oct": 10, "Nov": 11, "Dec": 12,
}

_AGE_LABELS = np.array(
    ["<1yr", "1-3yr", "3-7yr", "7-15yr", "15-30yr", "30+yr"], object
)
_AGE_EDGES = np.array([1.0, 3.0, 7.0, 15.0, 30.0])


def bucketize_age(ages: np.ndarray) -> np.ndarray:
    """Largest bucket boundary <= age (reference ml:43-48)."""
    ages = np.asarray(ages)
    idx = np.searchsorted(AGE_BUCKETS, ages, side="right") - 1
    return AGE_BUCKETS[np.clip(idx, 0, len(AGE_BUCKETS) - 1)]


def bucket_release_year(years: np.ndarray) -> np.ndarray:
    """5-year bin strings like '1990-1994'; NaN -> 'unknown'
    (reference ml:51-57)."""
    years = np.asarray(years, np.float64)
    out = np.full(years.shape, "unknown", object)
    ok = ~np.isnan(years)
    base = (years[ok].astype(np.int64) // 5) * 5
    out[ok] = [f"{b}-{b + 4}" for b in base]
    return out


def bucket_movie_age(years: np.ndarray) -> np.ndarray:
    """Movie age (float years) -> bucket string; NaN/negative -> 'unknown'
    (reference ml:60-75)."""
    years = np.asarray(years, np.float64)
    out = np.full(years.shape, "unknown", object)
    ok = ~np.isnan(years) & (years >= 0)
    idx = np.searchsorted(_AGE_EDGES, years[ok], side="right")
    out[ok] = _AGE_LABELS[idx]
    return out


def _days_to_weekday(days: np.ndarray) -> np.ndarray:
    """Epoch day -> weekday with Monday=0 (1970-01-01 was a Thursday)."""
    return (days + 3) % 7


def _parse_release_days(date_str: str) -> float:
    """'01-Jan-1995' -> days since epoch (UTC midnight); '' -> NaN."""
    if not date_str:
        return np.nan
    try:
        d, mon, y = date_str.split("-")
        return float(
            (
                np.datetime64(f"{int(y):04d}-{_MONTHS[mon]:02d}-{int(d):02d}")
                - np.datetime64("1970-01-01")
            ).astype(np.int64)
        )
    except (ValueError, KeyError):
        return np.nan


class MovieLensAdapter:
    """Index-based ML-100K pipeline producing train/val/test datasets.

    Entities are positional indices (user_idx in [0, U), item_idx in
    [0, M)); ``_user_enc``/``_item_enc`` hold per-entity ENCODED feature
    columns so any (user_idx, item_idx, context) triple assembles into a
    model row by fancy indexing alone.
    """

    def __init__(self, config: DataConfig, seed: int = 0) -> None:
        self.data_dir = Path(config.data_dir)
        self.config = config
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._schema: DatasetSchema | None = None

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------

    def build(
        self,
    ) -> tuple[DatasetSchema, TabularDataset, TabularDataset, TabularDataset]:
        self._load()
        if self.config.split_strategy == "temporal":
            self._temporal_split()
        else:
            self._leave_one_out_split()

        self._fit_encoders()
        self._schema = self._build_schema()

        train = self._assemble_train()
        val = self._assemble_eval(self._val_idx)
        test = self._assemble_eval(self._test_idx)
        return self._schema, train, val, test

    def resample_train(self) -> TabularDataset:
        """Fresh train negatives (called per epoch; reference ml:136-141)."""
        if self._schema is None:
            raise RuntimeError("Call build() first")
        return self._assemble_train()

    def rng_state(self) -> dict:
        """The state of the RNG the resamples draw from (a resume
        checkpoint carries it)."""
        return self._rng.bit_generator.state

    def set_rng_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state

    def score_interactions(
        self, path
    ) -> tuple[TabularDataset, np.ndarray, int]:
        """Batch-scoring (serving) entry point: transform an ARBITRARY
        u.data-format file (user \\t item \\t rating \\t timestamp; the
        rating column may be 0 for unlabeled traffic) with the FITTED
        train encoders, exactly as the training pipeline would.

        Rows whose raw user/movie id has no metadata row (u.user /
        u.item) are dropped — there is nothing to gather for them; the
        framework's OOV->0 convention applies to unseen CATEGORY VALUES
        of known entities (the encoders map those to index 0), not to
        entities with no features at all.

        Returns (dataset, kept_row_indices, total_rows). No reference
        counterpart (serving is out of the reference's scope,
        prd.md:23-27).
        """
        if self._schema is None:
            raise RuntimeError("Call build() first")
        raw = np.loadtxt(path, dtype=np.int64).reshape(-1, 4)
        ds, kept = self.score_id_pairs(
            raw[:, 0], raw[:, 1], raw[:, 2], raw[:, 3]
        )
        return ds, kept, len(raw)

    def score_id_pairs(
        self,
        users: np.ndarray,
        items: np.ndarray,
        ratings: np.ndarray | None = None,
        timestamps: np.ndarray | None = None,
    ) -> tuple[TabularDataset, np.ndarray]:
        """In-memory serving twin of ``score_interactions``: transform
        arbitrary (raw user id, raw item id) pairs with the FITTED train
        encoders — the entry point online scoring services use (no file
        round trip). ``timestamps`` default to the newest fitted
        interaction ("now" for this dataset); ``ratings`` default to 0
        (unlabeled traffic). Pairs whose user/item has no metadata row
        are dropped, mirroring ``score_interactions``.

        Returns (dataset, kept_row_indices). No reference counterpart
        (serving is out of the reference's scope, prd.md:23-27).
        """
        if self._schema is None:
            raise RuntimeError("Call build() first")
        users = np.asarray(users, np.int64).reshape(-1)
        items = np.asarray(items, np.int64).reshape(-1)
        if users.shape != items.shape:
            raise ValueError(
                f"users/items length mismatch: {len(users)} vs {len(items)}"
            )
        n = len(users)
        ratings = (
            np.zeros(n, np.int64)
            if ratings is None
            else np.asarray(ratings, np.int64).reshape(-1)
        )
        timestamps = (
            np.full(n, self.now_timestamp(), np.int64)
            if timestamps is None
            else np.asarray(timestamps, np.int64).reshape(-1)
        )
        if ratings.shape != users.shape:
            raise ValueError(
                f"ratings/users length mismatch: {len(ratings)} vs {n}"
            )
        if timestamps.shape != users.shape:
            raise ValueError(
                f"timestamps/users length mismatch: {len(timestamps)} vs {n}"
            )
        known = np.asarray(
            [
                int(u) in self._uid_pos and int(m) in self._mid_pos
                for u, m in zip(users, items)
            ],
            bool,
        )
        kept = np.nonzero(known)[0]
        uid = np.asarray(
            [self._uid_pos[int(u)] for u in users[kept]], np.int64
        )
        iid = np.asarray(
            [self._mid_pos[int(m)] for m in items[kept]], np.int64
        )
        ds = self._score_rows(uid, iid, ratings[kept], timestamps[kept])
        return ds, kept

    def now_timestamp(self) -> int:
        """"Now" for this dataset: the newest fitted interaction — the
        default request time for serving rows without a timestamp."""
        if self._schema is None:
            raise RuntimeError("Call build() first")
        return int(self._inter["timestamp"].max())

    def known_pair(self) -> tuple[int, int]:
        """One (raw user id, raw item id) this fit can score — serving
        warmup uses it to compile the eval scan on a guaranteed-kept
        row without reaching into the adapter's internals."""
        if self._schema is None:
            raise RuntimeError("Call build() first")
        return next(iter(self._uid_pos)), next(iter(self._mid_pos))

    def recommend_candidates(
        self,
        raw_user_id: int,
        exclude_seen: bool = True,
        timestamp: int | None = None,
    ) -> tuple[TabularDataset, np.ndarray]:
        """Top-K retrieval candidates: ONE user crossed with every item.

        Returns (dataset, raw_item_ids) — score the dataset and argsort
        to rank the catalog for this user. ``exclude_seen`` drops items
        the user already interacted with (the standard retrieval
        setting); ``timestamp`` stamps the request time for the
        time-derived features (defaults to the newest interaction in the
        fitted data, i.e. "now" for this dataset). No reference
        counterpart (serving is out of scope there, prd.md:23-27).
        """
        if self._schema is None:
            raise RuntimeError("Call build() first")
        if int(raw_user_id) not in self._uid_pos:
            raise ValueError(f"Unknown user id {raw_user_id}")
        upos = self._uid_pos[int(raw_user_id)]
        mask = (
            ~self._seen[upos]
            if exclude_seen
            else np.ones(self._n_items, bool)
        )
        items = np.nonzero(mask)[0]
        if timestamp is None:
            timestamp = int(self._inter["timestamp"].max())
        n = len(items)
        # positional indices straight into the encoder tables: the
        # catalog cross stays vectorized end to end
        ds = self._score_rows(
            np.full(n, upos, np.int64),
            items.astype(np.int64),
            np.zeros(n, np.int64),  # unlabeled traffic
            np.full(n, timestamp, np.int64),
        )
        return ds, self._mid_raw[items]

    def _score_rows(
        self,
        uid: np.ndarray,
        iid: np.ndarray,
        rating: np.ndarray,
        ts: np.ndarray,
    ) -> TabularDataset:
        """Transform rows of KNOWN entities with the fitted encoders —
        the shared serving core of score_interactions /
        recommend_candidates. Takes POSITIONAL user/item indices so the
        hot path (catalog retrieval crosses one user with every item)
        stays pure fancy-indexing, no per-row Python."""
        ts = np.asarray(ts, np.int64)

        # the same engineering as _load/_assemble, on arbitrary rows
        days = ts // 86400
        weekday = _days_to_weekday(days).astype(np.float64)
        hour = ((ts % 86400) // 3600).astype(np.float64)
        age_days = np.floor(ts / 86400.0 - self._release_days[iid])
        age_codes = self._age_enc.transform(
            bucket_movie_age(age_days / 365.25)
        )

        feats: dict[str, np.ndarray] = {}
        for name in ["user_id", "gender", "age", "occupation", "zip_prefix"]:
            feats[name] = self._user_enc[name][uid]
        for name in ["movie_id", "genres", "release_year_bucket", "num_genres"]:
            feats[name] = self._item_enc[name][iid]
        feats["movie_age_at_rating"] = age_codes
        feats["dow_sin"] = np.sin(2 * np.pi * weekday / 7).astype(np.float32)
        feats["dow_cos"] = np.cos(2 * np.pi * weekday / 7).astype(np.float32)
        feats["hour_sin"] = np.sin(2 * np.pi * hour / 24).astype(np.float32)
        feats["hour_cos"] = np.cos(2 * np.pi * hour / 24).astype(np.float32)
        feats["user_rating_count"] = self._user_enc["user_rating_count"][uid]
        feats["item_rating_count"] = self._item_enc["item_rating_count"][iid]

        labels = (
            np.asarray(rating, np.float64) >= self.config.label_threshold
        ).astype(np.float32)
        return TabularDataset(feats, labels)

    @property
    def schema(self) -> DatasetSchema:
        if self._schema is None:
            raise RuntimeError("Call build() first")
        return self._schema

    # ------------------------------------------------------------------
    # loading + feature engineering
    # ------------------------------------------------------------------

    def _load(self) -> None:
        # ---- u.user: id | age | gender | occupation | zip ----
        uid_raw, ages, genders, occs, zips = [], [], [], [], []
        for line in (self.data_dir / "u.user").read_text(
            encoding="latin-1"
        ).splitlines():
            if not line:
                continue
            p = line.split("|")
            uid_raw.append(int(p[0]))
            ages.append(int(p[1]))
            genders.append(p[2])
            occs.append(p[3])
            zips.append(p[4][:3])
        self._uid_raw = np.asarray(uid_raw, np.int64)
        self._u_age = bucketize_age(np.asarray(ages, np.int64))
        self._u_gender = np.asarray(genders, object)
        self._u_occ = np.asarray(occs, object)
        self._u_zip = np.asarray(zips, object)
        n_users = len(self._uid_raw)

        # ---- u.item: id | title | date | video | url | 19 genre flags ----
        mid_raw, rel_days, genre_lists, n_genres = [], [], [], []
        for line in (self.data_dir / "u.item").read_text(
            encoding="latin-1"
        ).splitlines():
            if not line:
                continue
            p = line.split("|")
            mid_raw.append(int(p[0]))
            rel_days.append(_parse_release_days(p[2]))
            flags = [int(v) for v in p[5 : 5 + len(GENRE_NAMES)]]
            genre_lists.append(
                [g for g, v in zip(GENRE_NAMES, flags) if v == 1]
            )
            n_genres.append(sum(flags))
        self._mid_raw = np.asarray(mid_raw, np.int64)
        self._release_days = np.asarray(rel_days, np.float64)
        self._genre_lists = genre_lists
        years = np.full(len(mid_raw), np.nan)
        ok = ~np.isnan(self._release_days)
        years[ok] = (
            self._release_days[ok]
            .astype(np.int64)
            .astype("datetime64[D]")
            .astype("datetime64[Y]")
            .astype(np.int64)
            + 1970
        )
        self._ryb = bucket_release_year(years)
        self._ngen = np.asarray([str(c) for c in n_genres], object)
        n_items = len(self._mid_raw)

        # ---- u.data: user \t item \t rating \t timestamp ----
        raw = np.loadtxt(self.data_dir / "u.data", dtype=np.int64)
        raw = raw.reshape(-1, 4)
        # raw id -> metadata row; kept for score_interactions (serving)
        self._uid_pos = {int(u): i for i, u in enumerate(self._uid_raw)}
        self._mid_pos = {int(m): i for i, m in enumerate(self._mid_raw)}
        uid_pos, mid_pos = self._uid_pos, self._mid_pos
        user_idx = np.asarray([uid_pos[int(u)] for u in raw[:, 0]], np.int64)
        item_idx = np.asarray([mid_pos[int(m)] for m in raw[:, 1]], np.int64)
        rating = raw[:, 2].astype(np.float64)
        ts = raw[:, 3].astype(np.int64)

        days = ts // 86400
        weekday = _days_to_weekday(days).astype(np.float64)
        hour = ((ts % 86400) // 3600).astype(np.float64)
        age_days = np.floor(ts / 86400.0 - self._release_days[item_idx])
        movie_age = bucket_movie_age(age_days / 365.25)

        self._inter = {
            "user_idx": user_idx,
            "item_idx": item_idx,
            "rating": rating,
            "timestamp": ts,
            "label": (rating >= self.config.label_threshold).astype(
                np.float32
            ),
            "dow_sin": np.sin(2 * np.pi * weekday / 7).astype(np.float32),
            "dow_cos": np.cos(2 * np.pi * weekday / 7).astype(np.float32),
            "hour_sin": np.sin(2 * np.pi * hour / 24).astype(np.float32),
            "hour_cos": np.cos(2 * np.pi * hour / 24).astype(np.float32),
            "movie_age": movie_age,
        }

        # seen matrix over ALL interactions (reference ml:287-290)
        self._seen = np.zeros((n_users, n_items), bool)
        self._seen[user_idx, item_idx] = True
        self._n_users = n_users
        self._n_items = n_items

    # ------------------------------------------------------------------
    # splits
    # ------------------------------------------------------------------

    def _temporal_split(self) -> None:
        """Global 80/10/10 by timestamp quantile; eval keeps one positive
        per train-seen user, first chronologically (reference ml:269-304)."""
        ts = self._inter["timestamp"]
        uid = self._inter["user_idx"]
        label = self._inter["label"]
        vr, tr = self.config.temporal_val_ratio, self.config.temporal_test_ratio
        c1 = np.quantile(ts, 1 - vr - tr)
        c2 = np.quantile(ts, 1 - tr)

        self._train_idx = np.flatnonzero(ts <= c1)
        val_all = np.flatnonzero((ts > c1) & (ts <= c2))
        test_all = np.flatnonzero(ts > c2)

        train_users = np.zeros(self._n_users, bool)
        train_users[uid[self._train_idx]] = True

        def first_positive_per_user(cand: np.ndarray) -> np.ndarray:
            cand = cand[(label[cand] == 1.0) & train_users[uid[cand]]]
            order = cand[np.argsort(ts[cand], kind="stable")]
            _, first = np.unique(uid[order], return_index=True)
            return order[first]

        self._val_idx = first_positive_per_user(val_all)
        self._test_idx = first_positive_per_user(test_all)

    def _leave_one_out_split(self) -> None:
        """Per user (>= min_interactions): last interaction -> test,
        second-to-last -> val, rest -> train (reference ml:235-267)."""
        ts = self._inter["timestamp"]
        uid = self._inter["user_idx"]
        order = np.lexsort((ts, uid))
        sorted_uid = uid[order]
        counts = np.bincount(uid, minlength=self._n_users)

        is_last = np.r_[sorted_uid[1:] != sorted_uid[:-1], True]
        last_pos = np.flatnonzero(is_last)
        eligible = counts[sorted_uid[last_pos]] >= self.config.min_interactions

        test_pos = last_pos[eligible]
        val_pos = test_pos - 1
        self._test_idx = order[test_pos]
        self._val_idx = order[val_pos]
        mask = np.ones(len(uid), bool)
        mask[self._test_idx] = False
        mask[self._val_idx] = False
        self._train_idx = np.flatnonzero(mask)

    # ------------------------------------------------------------------
    # encoders + schema
    # ------------------------------------------------------------------

    def _fit_encoders(self) -> None:
        tr = self._train_idx
        uid = self._inter["user_idx"][tr]
        iid = self._inter["item_idx"][tr]
        label = self._inter["label"][tr]

        enc_uid = LabelEncoder().fit(self._uid_raw[uid])
        enc_mid = LabelEncoder().fit(self._mid_raw[iid])
        enc_gender = LabelEncoder().fit(self._u_gender[uid])
        enc_age = LabelEncoder().fit(self._u_age[uid])
        enc_occ = LabelEncoder().fit(self._u_occ[uid])
        enc_zip = LabelEncoder().fit(self._u_zip[uid])
        enc_ryb = LabelEncoder().fit(self._ryb[iid])
        enc_ngen = LabelEncoder().fit(self._ngen[iid])
        self._age_enc = LabelEncoder().fit(self._inter["movie_age"][tr])
        genre_enc = MultiHotEncoder(max_length=6).fit(
            [self._genre_lists[i] for i in iid]
        )
        self._encoders = {
            "user_id": enc_uid,
            "movie_id": enc_mid,
            "gender": enc_gender,
            "age": enc_age,
            "occupation": enc_occ,
            "zip_prefix": enc_zip,
            "genres": genre_enc,
            "release_year_bucket": enc_ryb,
            "movie_age_at_rating": self._age_enc,
            "num_genres": enc_ngen,
        }

        # encoded entity tables: any row assembles by fancy indexing
        self._user_enc = {
            "user_id": enc_uid.transform(self._uid_raw),
            "gender": enc_gender.transform(self._u_gender),
            "age": enc_age.transform(self._u_age),
            "occupation": enc_occ.transform(self._u_occ),
            "zip_prefix": enc_zip.transform(self._u_zip),
        }
        self._item_enc = {
            "movie_id": enc_mid.transform(self._mid_raw),
            "genres": genre_enc.transform(self._genre_lists),
            "release_year_bucket": enc_ryb.transform(self._ryb),
            "num_genres": enc_ngen.transform(self._ngen),
        }
        # per-interaction movie-age codes (train positives' own context)
        self._inter["movie_age_enc"] = self._age_enc.transform(
            self._inter["movie_age"]
        )

        # dense count features from TRAIN POSITIVES only (reference
        # ml:334-344: scalers fitted on log1p of per-entity positive counts)
        pos = tr[label == 1.0]
        ucnt = np.bincount(
            self._inter["user_idx"][pos], minlength=self._n_users
        )
        icnt = np.bincount(
            self._inter["item_idx"][pos], minlength=self._n_items
        )
        u_scaler = MinMaxScaler().fit(np.log1p(ucnt[ucnt > 0]))
        i_scaler = MinMaxScaler().fit(np.log1p(icnt[icnt > 0]))
        self._user_enc["user_rating_count"] = u_scaler.transform(
            np.log1p(ucnt)
        ).astype(np.float32)
        self._item_enc["item_rating_count"] = i_scaler.transform(
            np.log1p(icnt)
        ).astype(np.float32)

        # popularity weights for eval negatives: count^alpha, min count 1
        # (reference ml:467-480)
        self._pop_weights = np.maximum(icnt, 1).astype(np.float64) ** (
            self.config.neg_sampling_alpha
        )

    def _build_schema(self) -> DatasetSchema:
        """16-field schema, reference dims (reference ml:346-418;
        total_embedding_dim = 108)."""
        e = self._encoders
        fields: dict[str, FieldSchema] = {}
        sparse = [
            ("user_id", 16, "user"),
            ("movie_id", 16, "item"),
            ("gender", 4, "user"),
            ("age", 4, "user"),
            ("occupation", 8, "user"),
            ("zip_prefix", 8, "user"),
        ]
        for name, dim, group in sparse:
            fields[name] = FieldSchema(
                name, FeatureType.SPARSE, e[name].vocabulary_size, dim, group
            )
        fields["genres"] = FieldSchema(
            "genres",
            FeatureType.SEQUENCE,
            e["genres"].vocabulary_size,
            8,
            "item",
            max_length=6,
            combiner="mean",
        )
        for name, dim, group in [
            ("release_year_bucket", 4, "item"),
            ("movie_age_at_rating", 4, "context"),
            ("num_genres", 4, "item"),
        ]:
            fields[name] = FieldSchema(
                name, FeatureType.SPARSE, e[name].vocabulary_size, dim, group
            )
        for name in ["dow_sin", "dow_cos", "hour_sin", "hour_cos"]:
            fields[name] = FieldSchema(
                name, FeatureType.DENSE, 0, 4, "context"
            )
        fields["user_rating_count"] = FieldSchema(
            "user_rating_count", FeatureType.DENSE, 0, 8, "user"
        )
        fields["item_rating_count"] = FieldSchema(
            "item_rating_count", FeatureType.DENSE, 0, 8, "item"
        )
        return DatasetSchema(fields=fields, label_field="label")

    # ------------------------------------------------------------------
    # negative sampling (vectorized numpy / native)
    # ------------------------------------------------------------------

    def _native(self):
        """The native sampler module when the config asks for it (built at
        its first call, raising if it cannot be), else None."""
        if not self.config.use_native_sampler:
            return None
        from deepfm_tpu_torch.native import sampler

        return sampler

    def _sample_train_negs(
        self, uids: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Uniform unseen items, without replacement per row; returns
        (flat_items, per_row_counts)."""
        native = self._native()
        if native is not None:
            seed = int(self._rng.integers(0, 2**62))
            out = native.uniform_unseen_batch(self._seen, uids, k, seed)
            return out.reshape(-1), np.full(len(uids), k, np.int64)

        rng = self._rng
        r = len(uids)
        n_unseen = self._n_items - self._seen.sum(1)
        # stable argsort of bool rows: unseen item indices come first
        cand = np.argsort(self._seen, axis=1, kind="stable")
        k_row = np.minimum(k, n_unseen[uids])
        draws = k + 8
        pick = rng.integers(
            0, np.maximum(n_unseen[uids], 1)[:, None], (r, draws)
        )
        items = cand[uids[:, None], pick]
        # first-k-unique per row (in draw order)
        o = np.argsort(items, axis=1, kind="stable")
        sv = np.take_along_axis(items, o, 1)
        first_sorted = np.concatenate(
            [np.ones((r, 1), bool), sv[:, 1:] != sv[:, :-1]], axis=1
        )
        first = np.zeros_like(first_sorted)
        np.put_along_axis(first, o, first_sorted, 1)
        rank = np.cumsum(first, 1) - 1
        keep = first & (rank < k_row[:, None])
        counts = keep.sum(1)

        # rare shortfall (collisions ate the oversample): per-row fix-up
        short = np.flatnonzero(counts < k_row)
        rows = [items[i][keep[i]] for i in range(r)]
        for i in short:
            have = set(rows[i].tolist())
            pool = cand[uids[i], : n_unseen[uids[i]]]
            extra = [x for x in pool if x not in have]
            need = int(k_row[i] - counts[i])
            sel = rng.permutation(len(extra))[:need]
            rows[i] = np.concatenate(
                [rows[i], np.asarray(extra, np.int64)[sel]]
            )
            counts[i] = k_row[i]
        return np.concatenate(rows) if rows else np.zeros(0, np.int64), counts

    def _sample_eval_negs(
        self, uids: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Popularity-weighted unseen items WITH replacement per row
        (random.choices semantics, reference ml:575-580)."""
        native = self._native()
        if native is not None:
            seed = int(self._rng.integers(0, 2**62))
            return native.weighted_unseen_batch(
                self._seen, self._pop_weights, uids, k, seed
            )

        rng = self._rng
        m = self._n_items
        rows, counts = [], np.zeros(len(uids), np.int64)
        for i, u in enumerate(uids):
            p = np.where(self._seen[u], 0.0, self._pop_weights)
            s = p.sum()
            avail = int((p > 0).sum())
            take = min(k, avail)
            if take == 0:
                rows.append(np.zeros(0, np.int64))
                continue
            rows.append(rng.choice(m, size=take, replace=True, p=p / s))
            counts[i] = take
        return (
            np.concatenate(rows) if rows else np.zeros(0, np.int64),
            counts,
        )

    # ------------------------------------------------------------------
    # row assembly
    # ------------------------------------------------------------------

    def _assemble(
        self,
        pos_idx: np.ndarray,
        neg_items: np.ndarray,
        neg_src: np.ndarray,
        shuffle: bool,
    ) -> TabularDataset:
        """Positives (interaction rows) + negatives (item swapped in,
        context copied from the source positive row) -> TabularDataset."""
        it = self._inter
        uid_all = np.concatenate([it["user_idx"][pos_idx], it["user_idx"][neg_src]])
        items_all = np.concatenate([it["item_idx"][pos_idx], neg_items])
        labels = np.concatenate(
            [it["label"][pos_idx], np.zeros(len(neg_items), np.float32)]
        )

        # movie-age for negatives: source row's timestamp vs neg release
        ts_neg = it["timestamp"][neg_src]
        age_days = np.floor(ts_neg / 86400.0 - self._release_days[neg_items])
        neg_age_codes = self._age_enc.transform(
            bucket_movie_age(age_days / 365.25)
        )
        age_codes = np.concatenate(
            [it["movie_age_enc"][pos_idx], neg_age_codes]
        )

        feats: dict[str, np.ndarray] = {}
        for name in ["user_id", "gender", "age", "occupation", "zip_prefix"]:
            feats[name] = self._user_enc[name][uid_all]
        for name in ["movie_id", "genres", "release_year_bucket", "num_genres"]:
            feats[name] = self._item_enc[name][items_all]
        feats["movie_age_at_rating"] = age_codes
        for name in ["dow_sin", "dow_cos", "hour_sin", "hour_cos"]:
            feats[name] = np.concatenate([it[name][pos_idx], it[name][neg_src]])
        feats["user_rating_count"] = self._user_enc["user_rating_count"][
            uid_all
        ]
        feats["item_rating_count"] = self._item_enc["item_rating_count"][
            items_all
        ]

        if shuffle:
            perm = self._rng.permutation(len(labels))
            feats = {k: v[perm] for k, v in feats.items()}
            labels = labels[perm]
        return TabularDataset(feats, labels)

    def _assemble_train(self) -> TabularDataset:
        pos_idx = self._train_idx
        uids = self._inter["user_idx"][pos_idx]
        k = self.config.num_neg_train
        if k > 0:
            neg_items, counts = self._sample_train_negs(uids, k)
            neg_src = np.repeat(pos_idx, counts)
        else:
            neg_items = np.zeros(0, np.int64)
            neg_src = np.zeros(0, np.int64)
        return self._assemble(pos_idx, neg_items, neg_src, shuffle=True)

    def _assemble_eval(self, pos_idx: np.ndarray) -> TabularDataset:
        uids = self._inter["user_idx"][pos_idx]
        neg_items, counts = self._sample_eval_negs(
            uids, self.config.num_neg_eval
        )
        neg_src = np.repeat(pos_idx, counts)
        return self._assemble(pos_idx, neg_items, neg_src, shuffle=False)
