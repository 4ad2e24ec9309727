from repro_torch.spectra.fdr import (
    decoy_competition,
    fdr_filter,
    make_decoys,
)
from repro_torch.spectra.preprocess import bin_spectra, bucket_by_precursor
from repro_torch.spectra.synthetic import (
    MSDataset,
    SyntheticMSConfig,
    generate_dataset,
    generate_query_set,
)

__all__ = ["MSDataset", "SyntheticMSConfig", "bin_spectra",
           "bucket_by_precursor", "decoy_competition", "fdr_filter",
           "generate_dataset", "generate_query_set", "make_decoys"]
