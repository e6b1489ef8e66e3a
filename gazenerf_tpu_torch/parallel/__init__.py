"""Training on more than one device over ``torch.distributed``: the process
mesh (``mesh``), the batch and ray split with the step's collectives
(``sharding``) and a multi-process run of the training CLI on tiny shapes
(``dryrun``)."""
