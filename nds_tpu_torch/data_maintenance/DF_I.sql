-- Copied from nds_tpu/data_maintenance/DF_I.sql, unchanged.
-- DF_I: delete inventory snapshots in the [DATE1, DATE2] window
-- (role of reference nds/data_maintenance/DF_I.sql).
DELETE FROM inventory WHERE inv_date_sk IN
  (SELECT d_date_sk FROM date_dim
   WHERE d_date BETWEEN CAST('DATE1' AS DATE) AND CAST('DATE2' AS DATE))
