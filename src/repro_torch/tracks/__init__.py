"""Aviation substrate: datasets, hierarchy, organize/archive/process workflow."""
