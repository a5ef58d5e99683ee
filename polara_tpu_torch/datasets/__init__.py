from polara_tpu_torch.datasets.synthetic import (ML1M_GEOMETRY,
                                                 ML10M_GEOMETRY,
                                                 make_realistic_coo_device,
                                                 make_synthetic_interactions)

__all__ = ["ML1M_GEOMETRY", "ML10M_GEOMETRY", "make_realistic_coo_device",
           "make_synthetic_interactions"]
