from .synthetic import cifarlike_dataset, dirichlet_partition
